"""Port parity: the Layer tier (paddle_tpu_torch/nn/layer/layers.py,
container.py, nn/initializer.py) and the layers of the BERT and GPT paths
against paddle_tpu, case by case after tests/test_nn_layers.py (the
layers this slice ports), then the Layer API of nn/layer/layers.py.

Layers with parameters take the JAX layer's weights (``functional_state``
copied into the port's layer as they are: both keep Linear's [in, out]);
outputs and gradients are compared at rtol 1e-5 / atol 1e-6 in f32.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import nn as jnn
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.bridge import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: one intra-op thread leaves the other cores to the
    timing-sensitive tests that run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _copy_weights(jlayer, tlayer):
    load_jax_params(tlayer, {k: np.asarray(v) for k, v in
                             jlayer.functional_state()[0].items()})


def _pair_forward(jlayer, tlayer, *arrays, grad=True):
    """Both layers on the same inputs: outputs and (with ``grad``) the
    parameters' and inputs' gradients of sum(out * c), compared."""
    _copy_weights(jlayer, tlayer)
    res = {}
    for p, layer in ((jp, jlayer), (tp, tlayer)):
        xs = [p.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
              for a in arrays]
        out = layer(*xs)
        c = np.random.RandomState(9).uniform(-1, 1, out.shape).astype(
            np.float32)
        res[p] = [out.numpy()]
        if grad:
            (out * p.to_tensor(c)).sum().backward()
            res[p] += [x.grad.numpy() for x in xs if not x.stop_gradient]
            res[p] += [prm.grad.numpy() for _, prm in
                       sorted(layer.named_parameters())]
    assert len(res[jp]) == len(res[tp])
    for a, b in zip(res[jp], res[tp]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)
    return res[tp][0]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_linear():
    layer = tnn.Linear(4, 3)
    assert tuple(layer.weight.shape) == (4, 3)          # JAX's [in, out]
    assert tuple(layer.bias.shape) == (3,)
    out = _pair_forward(jnn.Linear(4, 3), layer, _x(2, 4))
    np.testing.assert_allclose(out, _x(2, 4) @ layer.weight.numpy()
                               + layer.bias.numpy(), rtol=1e-5)
    assert len(layer.parameters()) == 2 and not layer.weight.stop_gradient
    assert tnn.Linear(4, 3, bias_attr=False).bias is None


def test_linear_fused_path_matches_amp_path():
    """Without AMP Linear is one addmm; under AMP matmul then add, the JAX
    package's two ops: the same values in f32 (O2 f32 is no cast)."""
    layer = tnn.Linear(8, 5)
    x = tp.to_tensor(_x(3, 8))
    plain = layer(x)
    y = tp.add(tp.matmul(x, layer.weight), layer.bias)
    np.testing.assert_allclose(plain.numpy(), y.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_layer_train_eval_dropout():
    layer = tnn.Dropout(0.5)
    x = tp.ones([100])
    layer.eval()
    np.testing.assert_allclose(layer(x).numpy(), np.ones(100))
    layer.train()
    out = layer(x).numpy()
    assert (out == 0).any() and (out > 1.0).any()


def test_sequential_and_state_dict():
    model = tnn.Sequential(tnn.Linear(4, 8), tnn.Linear(8, 2))
    jmodel = jnn.Sequential(jnn.Linear(4, 8), jnn.Linear(8, 2))
    out = _pair_forward(jmodel, model, _x(3, 4))
    sd = model.state_dict()
    assert list(sd) == list(jmodel.state_dict()) and len(sd) == 4
    model2 = tnn.Sequential(tnn.Linear(4, 8), tnn.Linear(8, 2))
    model2.set_state_dict(sd)
    np.testing.assert_array_equal(model2(tp.to_tensor(_x(3, 4))).numpy(),
                                  out)


def test_named_parameters_nested():
    def net(n):
        class Net(n.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = n.Linear(2, 3)
                self.sub = n.Sequential(n.Linear(3, 3))

            def forward(self, x):
                return self.sub(self.fc1(x))
        return Net()

    jnet, tnet = net(jnn), net(tnn)
    assert list(dict(tnet.named_parameters())) == \
        list(dict(jnet.named_parameters()))
    assert len(tnet.parameters()) == 4 and isinstance(tnet.parameters(),
                                                      list)
    _pair_forward(jnet, tnet, _x(5, 2))


def test_embedding_layer():
    emb = tnn.Embedding(10, 6, padding_idx=0)
    np.testing.assert_array_equal(emb.weight.numpy()[0], np.zeros(6))
    jemb = jnn.Embedding(10, 6, padding_idx=0)
    _copy_weights(jemb, emb)
    ids = np.array([[1, 2, 0]])
    out = emb(tp.to_tensor(ids))
    assert out.shape == (1, 3, 6)
    np.testing.assert_array_equal(out.numpy(), jemb(jp.to_tensor(ids))
                                  .numpy())
    np.testing.assert_allclose(out.numpy()[0, 2], np.zeros(6))


def test_layernorm_layer():
    out = _pair_forward(jnn.LayerNorm(8), tnn.LayerNorm(8), _x(4, 8))
    np.testing.assert_allclose(out.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.std(-1), 1.0, atol=1e-2)
    _pair_forward(jnn.LayerNorm([3, 8], epsilon=1e-3),
                  tnn.LayerNorm([3, 8], epsilon=1e-3), _x(2, 3, 8))


def test_multihead_attention():
    jp.seed(0)
    out = _pair_forward(jnn.MultiHeadAttention(16, 4),
                        tnn.MultiHeadAttention(16, 4), _x(2, 5, 16))
    assert out.shape == (2, 5, 16)
    # cross attention through the fused weight's q / k / v parts
    jm, tm = jnn.MultiHeadAttention(16, 4), tnn.MultiHeadAttention(16, 4)
    _copy_weights(jm, tm)
    q, kv = _x(2, 5, 16), _x(2, 7, 16, seed=1)
    j = jm(jp.to_tensor(q), jp.to_tensor(kv), jp.to_tensor(kv))
    t = tm(tp.to_tensor(q), tp.to_tensor(kv), tp.to_tensor(kv))
    assert t.shape == (2, 5, 16)
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5, atol=1e-6)
    # separate projections
    jm = jnn.MultiHeadAttention(16, 4, kdim=8, vdim=8)
    tm = tnn.MultiHeadAttention(16, 4, kdim=8, vdim=8)
    _copy_weights(jm, tm)
    kv = _x(2, 7, 8, seed=2)
    np.testing.assert_allclose(
        tm(tp.to_tensor(q), tp.to_tensor(kv), tp.to_tensor(kv)).numpy(),
        jm(jp.to_tensor(q), jp.to_tensor(kv), jp.to_tensor(kv)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_multihead_attention_mask_and_list_cache():
    jm, tm = jnn.MultiHeadAttention(16, 2), tnn.MultiHeadAttention(16, 2)
    _copy_weights(jm, tm)
    x = _x(2, 4, 16)
    mask = np.where(np.random.RandomState(3).rand(2, 1, 1, 4) > 0.3, 0.0,
                    -1e9).astype(np.float32)
    j = jm(jp.to_tensor(x), attn_mask=jp.to_tensor(mask))
    t = tm(tp.to_tensor(x), attn_mask=tp.to_tensor(mask))
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-5, atol=1e-6)
    jc, tc = jm.gen_cache(jp.to_tensor(x)), tm.gen_cache(tp.to_tensor(x))
    jo, (jk, _) = jm(jp.to_tensor(x), cache=jc)
    to, (tk, _) = tm(tp.to_tensor(x), cache=tc)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), rtol=1e-5, atol=1e-6)
    assert tk.shape == jk.shape == (2, 2, 4, 8)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder(normalize_before):
    def enc(n):
        layer = n.TransformerEncoderLayer(
            d_model=16, nhead=2, dim_feedforward=32, dropout=0.0,
            activation="gelu", normalize_before=normalize_before)
        return n.TransformerEncoder(layer, 2)

    tenc = enc(tnn)
    _pair_forward(enc(jnn), tenc, _x(2, 6, 16))
    assert all(p.grad is not None for p in tenc.parameters())
    assert list(dict(tenc.named_parameters())) == \
        list(dict(enc(jnn).named_parameters()))


def test_loss_layers():
    logits = _x(4, 10)
    labels = np.array([1, 2, -100, 4])
    res = {}
    for p, n in ((jp, jnn), (tp, tnn)):
        x = p.to_tensor(logits, stop_gradient=False)
        loss = n.CrossEntropyLoss()(x, p.to_tensor(labels))
        assert loss.shape == ()
        loss.backward()
        res[p] = (loss.numpy(), x.grad.numpy())
    for a, b in zip(res[jp], res[tp]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-7)


def test_forward_hooks():
    layer = tnn.Linear(2, 2)
    calls = []
    h = layer.register_forward_post_hook(
        lambda lyr, inp, out: calls.append(tuple(out.shape)))
    layer(tp.randn([3, 2]))
    assert calls == [(3, 2)]
    h.remove()
    layer(tp.randn([3, 2]))
    assert len(calls) == 1


def test_forward_pre_hook_replaces_inputs_and_post_hook_the_output():
    layer = tnn.Linear(2, 2)
    pre = layer.register_forward_pre_hook(lambda lyr, inp: (inp[0] * 0.0,))
    post = layer.register_forward_post_hook(lambda lyr, inp, out: out + 1.0)
    out = layer(tp.ones([1, 2]))
    np.testing.assert_allclose(out.numpy(), layer.bias.numpy()[None] + 1.0)
    pre.remove()
    post.remove()


def test_sublayer_replacement_and_apply():
    net = tnn.Sequential(tnn.Linear(2, 2), tnn.Linear(2, 2))
    count = [0]
    net.apply(lambda layer: count.__setitem__(0, count[0] + 1))
    assert count[0] == 3
    assert len(net.sublayers()) == 2 and len(
        net.sublayers(include_self=True)) == 3
    assert [n for n, _ in net.named_sublayers()] == ["0", "1"]


# -- the Layer API ------------------------------------------------------------

class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([3, 4])
        self.b = self.create_parameter([4], is_bias=True)
        self.register_buffer("steps", tp.zeros([1]))
        self.register_buffer("scratch", tp.zeros([2]), persistable=False)
        self.fc = tnn.Linear(4, 2)

    def forward(self, x):
        return self.fc(tp.matmul(x, self.w) + self.b)


def test_create_parameter_defaults_and_attrs():
    net = _Net()
    assert isinstance(net.w, tp.Parameter) and isinstance(
        net.w, torch.nn.Parameter) and isinstance(net.w, tp.Tensor)
    limit = (6.0 / 7.0) ** 0.5                 # Xavier-uniform on [3, 4]
    w = net.w.detach()
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.1
    np.testing.assert_array_equal(net.b.numpy(), np.zeros(4))
    p = net.create_parameter([2], attr=tnn.ParamAttr(
        name="fixed", initializer=tnn.initializer.Constant(3.0),
        trainable=False, learning_rate=0.5))
    assert p.name == "fixed" and p.stop_gradient and not p.trainable
    assert p.optimize_attr == {"learning_rate": 0.5}
    np.testing.assert_array_equal(p.numpy(), [3.0, 3.0])
    assert net.create_parameter([2], attr=False) is None
    assert net.create_parameter([2], dtype="float16").dtype == torch.float16


def test_add_parameter_add_sublayer_and_assignment():
    net = tnn.Layer()
    p = net.add_parameter("p", tp.Parameter(torch.ones(2)))
    assert net.p is p and "p" in dict(net.named_parameters())
    sub = net.add_sublayer("lin", tnn.Linear(2, 2))
    assert net.lin is sub
    with pytest.raises(TypeError):
        net.add_parameter("q", tp.to_tensor([1.0]))
    net.p = tp.to_tensor([5.0, 6.0])          # a tensor into a parameter
    assert net.p is p
    np.testing.assert_array_equal(p.numpy(), [5.0, 6.0])


def test_buffers_and_state_dict_keys():
    net = _Net()
    keys = list(net.state_dict())
    assert keys == ["w", "b", "steps", "fc.weight", "fc.bias"]
    assert "scratch" not in keys and len(net.buffers()) == 2
    assert [n for n, _ in net.named_buffers()] == ["steps", "scratch"]
    assert list(net.state_dict(include_sublayers=False)) == ["w", "b",
                                                              "steps"]


def test_set_state_dict_takes_numpy_and_reports():
    net, other = _Net(), _Net()
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    state["unused"] = np.zeros(1)
    del state["b"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        missing, unexpected = other.set_state_dict(state)
    assert missing == ["b"] and unexpected == ["unused"] and len(w) == 2
    np.testing.assert_array_equal(other.w.numpy(), net.w.numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        other.set_state_dict({"w": np.zeros((4, 3))})


def test_set_state_dict_by_parameter_name():
    net = tnn.Linear(2, 3)
    state = {net.weight.name: np.ones((2, 3), np.float32),
             net.bias.name: np.full(3, 2.0, np.float32)}
    net.set_state_dict(state, use_structured_name=False)
    np.testing.assert_array_equal(net.weight.numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(net.bias.numpy(), [2.0, 2.0, 2.0])


def test_state_dict_survives_save_and_load(tmp_path):
    net = _Net()
    tp.save(net.state_dict(), str(tmp_path / "m.pdparams"))
    other = _Net()
    other.set_state_dict(tp.load(str(tmp_path / "m.pdparams")))
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


def test_functional_state_roundtrip_matches_jax_names():
    jnet = jnn.Sequential(jnn.Linear(3, 4), jnn.LayerNorm(4))
    tnet = tnn.Sequential(tnn.Linear(3, 4), tnn.LayerNorm(4))
    jparams, _ = jnet.functional_state()
    tparams, tbufs = tnet.functional_state()
    assert list(tparams) == list(jparams) and tbufs == {}
    tnet.load_functional_state({k: np.asarray(v) for k, v in
                                jparams.items()})
    for k, v in jparams.items():
        np.testing.assert_array_equal(tnet.state_dict()[k].numpy(),
                                      np.asarray(v))


def test_to_astype_and_full_name():
    net = _Net()
    net.to(dtype="bfloat16")
    assert net.w.dtype == torch.bfloat16 and isinstance(net.w, tp.Parameter)
    net.astype("float32")
    assert net.fc.weight.dtype == torch.float32
    net.to(device="cpu")
    net.to("cpu")
    assert net.w.device.type == "cpu"
    assert net.full_name().startswith("_net_")
    assert net.full_name() != _Net().full_name()


def test_parameter_deepcopy_keeps_paddle_attributes():
    lin = tnn.Linear(2, 2, weight_attr=tnn.ParamAttr(name="kept"))
    dup = copy.deepcopy(lin)
    assert dup.weight.name == "kept" and isinstance(dup.weight, tp.Parameter)
    assert dup.weight is not lin.weight
    assert torch.equal(dup.weight, lin.weight)


# -- containers ---------------------------------------------------------------

def test_layer_list_and_dict_and_parameter_list():
    ll = tnn.LayerList([tnn.Linear(2, 2)])
    ll.append(tnn.Linear(2, 3)).extend([tnn.Linear(3, 3)])
    ll.insert(0, tnn.Linear(2, 2))
    assert len(ll) == 4 and len(ll.parameters()) == 8
    assert isinstance(ll[1:], tnn.LayerList) and len(ll[1:]) == 3
    ld = tnn.LayerDict({"a": tnn.Linear(2, 2)})
    ld["b"] = tnn.Linear(2, 3)
    assert list(ld.keys()) == ["a", "b"] and "b" in ld
    assert ld.pop("a") is not None and len(ld) == 1
    pl = tnn.ParameterList([tp.Parameter(torch.ones(2))])
    pl.append(tp.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and len(pl.parameters()) == 2
    seq = tnn.Sequential(("first", tnn.Linear(2, 2)),
                         ("second", tnn.Linear(2, 1)))
    assert list(dict(seq.named_parameters())) == [
        "first.weight", "first.bias", "second.weight", "second.bias"]
    assert isinstance(seq[:1], tnn.Sequential) and len(seq) == 2


# -- initializers -------------------------------------------------------------

@pytest.mark.parametrize("make, mean, sd", [
    (lambda I: I.Uniform(-2.0, 2.0), 0.0, 4 / 12 ** 0.5),
    (lambda I: I.Normal(1.0, 0.5), 1.0, 0.5),
    (lambda I: I.TruncatedNormal(0.0, 1.0), 0.0, 0.8796),
    (lambda I: I.XavierUniform(), 0.0, (6 / 128) ** 0.5 / 3 ** 0.5),
    (lambda I: I.XavierNormal(), 0.0, (2 / 128) ** 0.5),
    (lambda I: I.KaimingUniform(), 0.0, (6 / 64) ** 0.5 / 3 ** 0.5),
    (lambda I: I.KaimingNormal(), 0.0, (2 / 64) ** 0.5),
])
def test_initializers_match_jax_in_distribution(make, mean, sd):
    jp.seed(0)
    tp.seed(0)
    j = np.asarray(make(jnn.initializer)([64, 64], "float32"))
    t = make(tnn.initializer)([64, 64], "float32").numpy()
    for a in (j, t):
        assert a.shape == (64, 64)
        assert abs(a.mean() - mean) < 4 * sd / 64
        assert abs(a.std() - sd) < 0.05 * sd
    tp.seed(3)
    first = make(tnn.initializer)([8], "float32")
    tp.seed(3)
    assert torch.equal(make(tnn.initializer)([8], "float32"), first)


def test_constant_assign_and_gain_match_jax():
    for (jv, tv) in ((jnn.initializer.Constant(2.5)([3], "float32"),
                      tnn.initializer.Constant(2.5)([3], "float32")),
                     (jnn.initializer.Assign(np.arange(4.0))([4]),
                      tnn.initializer.Assign(np.arange(4.0))([4]))):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for nl in ("tanh", "relu", "leaky_relu", "selu", "sigmoid"):
        assert tnn.initializer.calculate_gain(nl) == \
            jnn.initializer.calculate_gain(nl)
    with pytest.raises(ValueError):
        tnn.initializer.Assign(np.zeros(3))([4])
