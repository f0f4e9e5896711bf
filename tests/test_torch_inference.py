"""Port parity: the Predictor over ``jit.save`` artifacts
(paddle_tpu_torch/inference, framework/crypto.py) against
paddle_tpu/inference.

The Predictor over the ``.pt2`` (the port's counterpart of JAX's
``.stablehlo``) and over the ``.pdmodel`` Program equals eager and JAX's
Predictor on the same weights (f32 to 1e-5; a tiny BERT through the
attention composite and through the flash route against JAX's eager
output, since JAX's own jit.save of BERT fails in its rewriter, see
test_torch_program_serde.py); JAX's precedence holds
(the exported program first, the Program when it is absent);
``encrypt_model`` + ``Config.set_cipher_key`` round-trip and a missing
key raises ``PermissionError``. ``test_torch_export_decode.py`` keeps the
decode ``.pt2``.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.inference as jinference
import paddle_tpu_torch as tp
import paddle_tpu_torch.inference as tinference
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.ops import cuda as kernels

from test_torch_static_cases import JAX, PORT, to_np


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _bert_pair(seq):
    from paddle_tpu.text.models import bert as jb
    from paddle_tpu_torch.text.models import bert as tb
    jnet = jb.Bert(jb.BertConfig.tiny())
    tnet = tb.Bert(tb.BertConfig.tiny(), device="cpu")
    params, _ = jnet.functional_state()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in params.items()})
    jnet.eval()
    tnet.eval()
    ids = np.random.RandomState(0).randint(0, 1024, (2, seq)).astype(
        "int64")
    return jnet, tnet, ids


def _close(got, want, tol=1e-5):
    assert float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


def test_save_writes_artifacts(tmp_path):
    net = tp.nn.Linear(4, 2)
    path = str(tmp_path / "m")
    tp.jit.save(net, path,
                input_spec=[tp.jit.InputSpec([None, 4], "float32", "x")])
    assert sorted(os.listdir(tmp_path)) == [
        "m.pdinfer.json", "m.pdiparams", "m.pdmodel", "m.pdmodel.npz",
        "m.pt2"]


@pytest.mark.parametrize("seq", [16, 128])
def test_predictor_routes_equal_eager_and_jax(seq, tmp_path):
    jnet, tnet, ids = _bert_pair(seq)
    want = to_np(tnet(tp.to_tensor(ids)))
    path = str(tmp_path / "port")
    tp.jit.save(tnet, path,
                input_spec=[tp.jit.InputSpec([None, seq], "int64", "ids")])
    before = kernels.launch_counts()
    pt2 = tinference.create_predictor(tinference.Config(path))
    assert pt2._program is not None and pt2._translated is None
    got_pt2 = pt2.run([ids])[0]
    os.rename(path + ".pt2", path + ".pt2.off")
    pd = tinference.create_predictor(tinference.Config(path + ".pdmodel"))
    assert pd._translated is not None
    got_pd = pd.run([ids])[0]
    _close(got_pt2, want)
    _close(got_pd, want)
    _close(want, to_np(jnet(jp.to_tensor(ids))))
    assert pd.get_input_names() == ["ids"]
    assert pd.get_output_names() == ["fetch_0"]
    after = kernels.launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"]   # CPU: plain versions


def test_predictor_handles_and_batch(tmp_path):
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.Tanh(),
                           tp.nn.Linear(8, 3))
    net.eval()
    path = str(tmp_path / "mlp")
    tp.jit.save(net, path,
                input_spec=[tp.jit.InputSpec([None, 4], "float32", "x")])
    pred = tinference.create_predictor(tinference.Config(path))
    for b in (1, 5):
        x = np.random.RandomState(b).rand(b, 4).astype("float32")
        h = pred.get_input_handle("x")
        h.copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle("fetch_0").copy_to_cpu()
        _close(out, to_np(net(tp.to_tensor(x))))


def test_predictor_matches_jax_predictor_on_an_mlp(tmp_path):
    jnet = jp.nn.Sequential(jp.nn.Linear(4, 8), jp.nn.ReLU(),
                            jp.nn.Linear(8, 2))
    tnet = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),
                            tp.nn.Linear(8, 2))
    params, _ = jnet.functional_state()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in params.items()})
    x = np.random.RandomState(3).rand(2, 4).astype("float32")
    outs = {}
    for P, net, inf in ((JAX, jnet, jinference), (PORT, tnet, tinference)):
        net.eval()
        path = str(tmp_path / P.name)
        P.jit.save(net, path,
                   input_spec=[P.jit.InputSpec([2, 4], "float32", "x")])
        outs[P.name] = inf.create_predictor(inf.Config(path)).run([x])[0]
    _close(outs["port"], outs["jax"])


def test_control_flow_layer_serves_through_the_pdmodel(tmp_path):
    class LoopNet(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter(
                [1], default_initializer=tp.nn.initializer.Constant(2.0))

        def forward(self, x):
            s = x
            while s.sum() < 50.0:
                s = s * self.scale
            return s

    net = LoopNet()
    path = str(tmp_path / "loop")
    tp.jit.save(net, path,
                input_spec=[tp.jit.InputSpec([2, 2], "float32", "x")])
    assert not os.path.exists(path + ".pt2")   # a host read: no export
    pred = tinference.create_predictor(tinference.Config(path))
    for v in (1.0, 4.0):
        x = np.full((2, 2), v, "float32")
        np.testing.assert_array_equal(pred.run([x])[0],
                                      to_np(net(tp.to_tensor(x))))


def test_encrypted_model_round_trip(tmp_path):
    from paddle_tpu_torch.framework.crypto import Cipher, CipherUtils
    net = tp.nn.Linear(4, 2)
    net.eval()
    path = str(tmp_path / "enc")
    tp.jit.save(net, path,
                input_spec=[tp.jit.InputSpec([None, 4], "float32", "x")])
    x = np.random.RandomState(4).rand(3, 4).astype("float32")
    want = to_np(net(tp.to_tensor(x)))
    key = CipherUtils.gen_key()
    tinference.encrypt_model(path, key)
    assert not os.path.exists(path + ".pt2")
    assert os.path.exists(path + ".pt2.enc")
    with pytest.raises(PermissionError, match="set_cipher_key"):
        tinference.create_predictor(tinference.Config(path))
    cfg = tinference.Config(path)
    cfg.set_cipher_key(key)
    _close(tinference.create_predictor(cfg).run([x])[0], want)
    cfg2 = tinference.Config(path)
    cfg2.set_cipher_key(CipherUtils.gen_key())
    from cryptography.exceptions import InvalidTag
    with pytest.raises(InvalidTag):
        tinference.create_predictor(cfg2)
    blob = Cipher(key).encrypt(b"payload")
    assert Cipher(key).decrypt(blob) == b"payload"
    with pytest.raises(ValueError, match="32 bytes"):
        Cipher(b"short")


def test_missing_model_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="jit.save"):
        tinference.create_predictor(tinference.Config(
            str(tmp_path / "none")))
