"""Port parity: the encoder-decoder Transformer (paddle_tpu_torch/nn/
layer/transformer.py) against paddle_tpu's, and the static-cache
attention in training mode (ROADMAP Queue 3 C6).

A tiny sequence-to-sequence model, built the same way from each package's
public surface: a shared embedding (scaled by sqrt(d)), ``nn.Transformer``
at d 64, 2 heads, 2 + 2 layers, FFN 128, dropout 0, and the output tied
to the embedding through ``F.fused_linear_cross_entropy``. The source
padding mask is a bool [b, 1, 1, s_src] (``src_mask`` and
``memory_mask``), the target mask ``generate_square_subsequent_mask``.
Weights go across by module path (``bridge.load_jax_params``).

- With ``FLAGS_flash_min_seq=0`` in both packages the encoder's
  self-attention and the cross-attention take the flash route (the JAX
  package's Pallas kernels in interpret mode, the port's plain versions)
  and the decoder's [s, s] mask is rejected as ``shape``; without it every
  attention runs the composite. Loss within 1e-4 and every gradient
  within 1e-5 absolute plus 1e-4 relative (f32; XLA's and torch's CPU
  matmuls sum in other orders, and the sqrt(d)-scaled embeddings make
  the gradients up to ~0.2, where the sums differ by ~2e-5).
- Greedy decoding through the decoder's StaticKVCaches (eval): the same
  tokens as the JAX cached decode, the last logits within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.core import tape as _tape
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import monitor as tmonitor

ATOL = 1e-4
GRAD_TOL = 1e-5
GRAD_RTOL = 1e-4
V, D, H, FFN, LAYERS = 50, 64, 2, 128, 2
B, S_SRC, S_TGT, PAD = 2, 16, 12, 0
NEW_TOKENS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def seq2seq(pkg):
    """The test model in ``pkg`` (either package)."""
    F = pkg.nn.functional

    class Seq2Seq(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pkg.nn.Embedding(V, D)
            self.tf = pkg.nn.Transformer(D, H, LAYERS, LAYERS, FFN,
                                         dropout=0.0)

        def embed(self, ids):
            return self.emb(ids) * (D ** 0.5)

        def forward(self, src, tgt, src_mask, tgt_mask, labels):
            h = self.tf(self.embed(src), self.embed(tgt), src_mask,
                        tgt_mask, src_mask)
            return F.fused_linear_cross_entropy(h, self.emb.weight, None,
                                                labels, ignore_index=PAD)

        def greedy(self, src, src_mask, first, n):
            """n greedy tokens through the decoder's StaticKVCaches."""
            memory = self.tf.encoder(self.embed(src), src_mask=src_mask)
            caches = self.tf.decoder.gen_static_cache(src.shape[0], 16,
                                                      "float32")
            tok, toks = first, []
            for _ in range(n):
                out, caches = self.tf.decoder(self.embed(tok), memory,
                                              memory_mask=src_mask,
                                              cache=caches)
                logits = pkg.matmul(out, self.emb.weight, transpose_y=True)
                tok = pkg.argmax(logits, axis=-1)
                toks.append(np.asarray(tok.numpy())[:, 0])
            return np.stack(toks, 1), np.asarray(logits.numpy())
    return Seq2Seq()


def _data():
    rng = np.random.RandomState(0)
    src = rng.randint(1, V, (B, S_SRC))
    src[1, 11:] = PAD
    tgt = rng.randint(1, V, (B, S_TGT))
    labels = np.roll(tgt, -1, axis=1)
    labels[1, 8:] = PAD
    mask = (src != PAD)[:, None, None, :]
    return src, tgt, mask, labels


def _inputs(pkg, src, tgt, mask, labels):
    t = pkg.to_tensor
    return (t(src), t(tgt), t(mask),
            pkg.nn.Transformer.generate_square_subsequent_mask(S_TGT),
            t(labels))


@pytest.fixture(scope="module", params=["flash", "composite"])
def route(request):
    """flash: FLAGS_flash_min_seq=0 in both packages (the JAX kernels in
    interpret mode); composite: each package's default gate."""
    if request.param == "composite":
        yield request.param
        return
    min_seq = tflags.flag("FLAGS_flash_min_seq")
    jp.set_flags({"FLAGS_pallas_interpret": True,
                  "FLAGS_flash_attention_interpret": True,
                  "FLAGS_flash_min_seq": 0})
    tflags.set_flags({"FLAGS_flash_min_seq": 0})
    yield request.param
    jp.set_flags({"FLAGS_pallas_interpret": False,
                  "FLAGS_flash_attention_interpret": False,
                  "FLAGS_flash_min_seq": 1024})
    tflags.set_flags({"FLAGS_flash_min_seq": min_seq})


@pytest.fixture(scope="module")
def jax_model():
    jp.seed(0)
    net = seq2seq(jp)
    net.eval()
    return net


def _jax_loss_and_grads(jnet, data):
    params, buffers = jnet.functional_state()
    args = _inputs(jp, *data)

    def loss_of(p):
        jnet.load_functional_state(p, buffers)
        return jnet(*args)._value

    try:
        with _tape.no_grad():
            loss, grads = jax.value_and_grad(loss_of)(params)
    finally:
        jnet.load_functional_state(params, buffers)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_model(jnet):
    tnet = seq2seq(tp)
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    tnet.eval()
    return tnet


def test_loss_and_every_grad_match_jax(jax_model, route):
    data = _data()
    jloss, jgrads = _jax_loss_and_grads(jax_model, data)
    tnet = _port_model(jax_model)
    tmonitor.reset(prefix="cuda.")
    loss = tnet(*_inputs(tp, *data))
    loss.backward()
    gates = tmonitor.stats("cuda.")
    if route == "flash":
        # 2 encoder self-attentions and 2 cross-attentions on the kernels,
        # the 2 decoder self-attentions rejected for their [s, s] mask
        assert gates == {"cuda.hit.flash_attention": 2 * LAYERS,
                         "cuda.gate_reject.flash_attention.shape": LAYERS}
    else:
        assert gates == {
            "cuda.gate_reject.flash_attention.min_seq": 3 * LAYERS}
    np.testing.assert_allclose(float(loss.detach()), jloss, atol=ATOL)
    checked = 0
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name],
                                   atol=GRAD_TOL, rtol=GRAD_RTOL,
                                   err_msg=name)
        checked += 1
    assert checked == len(jgrads) == 61


def test_cached_greedy_decode_matches_jax(jax_model, route):
    src, _, mask, _ = _data()
    first = np.full((B, 1), 3, np.int64)
    with _tape.no_grad():
        jtok, jlogits = jax_model.greedy(jp.to_tensor(src),
                                         jp.to_tensor(mask),
                                         jp.to_tensor(first), NEW_TOKENS)
    tnet = _port_model(jax_model)
    tmonitor.reset(prefix="cuda.")
    with torch.no_grad():
        ttok, tlogits = tnet.greedy(tp.to_tensor(src), tp.to_tensor(mask),
                                    tp.to_tensor(first), NEW_TOKENS)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tlogits, jlogits, atol=ATOL)
    # eval mode: the decode kernel's gate admits every cached step
    assert not any("decode_attention" in k for k in tmonitor.stats("cuda."))


def test_square_subsequent_mask_matches_jax():
    j = np.asarray(jp.nn.Transformer.generate_square_subsequent_mask(
        5).numpy())
    t = tp.nn.Transformer.generate_square_subsequent_mask(5)
    assert t.dtype == torch.float32 and isinstance(t, tp.Tensor)
    np.testing.assert_array_equal(t.numpy(), j)


def test_defaults_are_transformer_base():
    net = tp.nn.Transformer()
    n = sum(p.numel() for p in net.parameters())
    assert (net.d_model, net.nhead) == (512, 8)
    assert len(net.encoder.layers) == len(net.decoder.layers) == 6
    assert net.encoder.layers[0].linear1.weight.shape == (512, 2048)
    assert net.encoder.norm is None and net.decoder.norm is None
    assert n == sum(int(np.prod(p.shape)) for p in
                    jp.nn.Transformer().parameters()) == 44138496


def test_quirk_jax_transformer_layers_share_parameter_names():
    """Reference quirk (ROADMAP Queue 3): JAX's TransformerEncoder and
    TransformerDecoder deep-copy one layer, so on a 2 + 2 Transformer its
    60 parameters carry 30 names. The bridge maps by module path, which
    is unique in both; the port's parameter names are unique too."""
    jnet = jp.nn.Transformer(D, H, 2, 2, FFN)
    jparams = jnet.parameters()
    assert len(jparams) == 60 and len({p.name for p in jparams}) == 30
    jpaths = list(jnet.functional_state()[0])
    tnet = tp.nn.Transformer(D, H, 2, 2, FFN)
    tnames = [p.name for p in tnet.parameters()]
    assert len(set(tnames)) == len(tnames) == 60
    assert [k for k, _ in tnet.named_parameters()] == jpaths
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    for k, p in tnet.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(), np.asarray(jnet.functional_state()[0][k]))


# -- C6: static-cache attention in training mode -----------------------------

def _decoder_layers():
    jp.seed(1)
    jlayer = jp.nn.TransformerDecoderLayer(D, H, FFN, dropout=0.0)
    tlayer = tp.nn.TransformerDecoderLayer(D, H, FFN, dropout=0.0)
    load_jax_params(tlayer, {k: np.asarray(v) for k, v in
                             jlayer.functional_state()[0].items()})
    return jlayer, tlayer


def test_train_mode_static_cache_matches_jax():
    """A decoder layer left in train() mode with a StaticKVCache (dropout
    0): the JAX gate rejects the decode kernel as ``training`` and runs
    ``_static_cache_attention``; the port does the same, counted under
    the same reason, and the outputs agree within the f32 limit."""
    jlayer, tlayer = _decoder_layers()
    jlayer.train()
    tlayer.train()
    rng = np.random.RandomState(3)
    mem = rng.randn(B, 7, D).astype(np.float32)
    jc, tc = jlayer.gen_static_cache(B, 8), tlayer.gen_static_cache(B, 8)
    tmonitor.reset(prefix="cuda.")
    for step in range(3):
        x = rng.randn(B, 1 if step else 2, D).astype(np.float32)
        jo, jc = jlayer(jp.to_tensor(x), jp.to_tensor(mem), cache=jc)
        to, tc = tlayer(tp.to_tensor(x), tp.to_tensor(mem), cache=tc)
        np.testing.assert_allclose(to.detach().numpy(),
                                   np.asarray(jo.numpy()), atol=ATOL)
    assert tc.index == 4
    assert tmonitor.stats("cuda.gate_reject.decode_attention") == {
        "cuda.gate_reject.decode_attention.training": 3}


def test_train_mode_static_cache_with_dropout_runs():
    """At dropout > 0 the cached step drops probabilities and does not
    raise; the output is finite, and differs from the eval output."""
    tlayer = tp.nn.TransformerDecoderLayer(D, H, FFN, dropout=0.0,
                                           attn_dropout=0.5)
    rng = np.random.RandomState(4)
    x = tp.to_tensor(rng.randn(B, 3, D).astype(np.float32))
    mem = tp.to_tensor(rng.randn(B, 5, D).astype(np.float32))
    tlayer.train()
    out, cache = tlayer(x, mem, cache=tlayer.gen_static_cache(B, 8))
    assert cache.index == 3 and torch.isfinite(out).all()
    tlayer.eval()
    ref, _ = tlayer(x, mem, cache=tlayer.gen_static_cache(B, 8))
    assert not torch.allclose(out, ref)


def test_decode_flag_off_runs_the_plain_cache_attention():
    _, tlayer = _decoder_layers()
    tlayer.eval()
    x = tp.to_tensor(np.ones((B, 2, D), np.float32))
    mem = tp.to_tensor(np.ones((B, 3, D), np.float32))
    on, _ = tlayer(x, mem, cache=tlayer.gen_static_cache(B, 8))
    tflags.set_flags({"FLAGS_use_decode_attention": False})
    tmonitor.reset(prefix="cuda.")
    try:
        off, _ = tlayer(x, mem, cache=tlayer.gen_static_cache(B, 8))
    finally:
        tflags.set_flags({"FLAGS_use_decode_attention": True})
    assert tmonitor.stats("cuda.gate_reject.decode_attention") == {
        "cuda.gate_reject.decode_attention.flag_off": 1}
    np.testing.assert_allclose(off.numpy(), on.numpy(), atol=1e-5)
