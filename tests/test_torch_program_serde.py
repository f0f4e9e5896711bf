"""Port parity: the versioned .pdmodel format
(paddle_tpu_torch/framework/program_serde.py) against
paddle_tpu/framework/program_serde.py.

tests/test_program_serde.py's in-process cases run on both packages, and
artifacts cross packages: a tiny BERT and GPT saved by JAX's ``jit.save``
run in the port's ``jit.load`` with JAX's outputs, and the port's
artifacts run in JAX's ``jit.load`` with the port's (weights copied by
module path, f32, 1e-5 relative to the largest |output| unless stated).
At s 16 both packages record the attention composite ``sdpa``; at s 128
(``FLAGS_flash_min_seq``) the port records ``flash_sdpa``, which JAX's
loader runs through its Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import JAX, PKGS, PORT, to_np


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def _serde(P):
    return __import__(P.paddle.__name__ + ".framework.program_serde",
                      fromlist=["save_program"])


def _small_net(P):
    class SmallNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = P.nn.Linear(4, 8)
            self.fc2 = P.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(P.ops.relu(self.fc1(x)))
    net = SmallNet()
    net.eval()
    return net


def _save(P, net, tmp, name="m", shape=(2, 4), dtype="float32"):
    path = os.path.join(str(tmp), name)
    P.jit.save(net, path, input_spec=[P.jit.InputSpec(list(shape), dtype,
                                                       "x")])
    return path


def test_pdmodel_is_json_schema_without_qualnames(P, tmp_path):
    path = _save(P, _small_net(P), tmp_path)
    raw = open(path + ".pdmodel", "rb").read()
    doc = json.loads(raw)
    assert doc["format_version"] == _serde(P).FORMAT_VERSION == 1
    assert doc["op_versions"]
    assert b"paddle_tpu" not in raw and b"__module__" not in raw
    assert os.path.exists(path + ".pdmodel.npz")


def test_save_load_numeric_roundtrip(P, tmp_path):
    net = _small_net(P)
    x = np.random.RandomState(0).randn(2, 4).astype("float32")
    want = to_np(net(P.paddle.to_tensor(x)))
    loaded = P.jit.load(_save(P, net, tmp_path))
    np.testing.assert_allclose(to_np(loaded(P.paddle.to_tensor(x))), want,
                               rtol=1e-5, atol=1e-6)


def test_op_version_gate(P, tmp_path):
    serde = _serde(P)
    path = _save(P, _small_net(P), tmp_path)
    with open(path + ".pdmodel") as f:
        doc = json.load(f)
    bumped = False
    for op in doc["ops"]:
        if op["fn"].get("__opreg__") == "matmul":
            op["fn"]["version"] = 99
            bumped = True
    assert bumped
    doc["op_versions"]["matmul"] = 99
    with open(path + ".pdmodel", "w") as f:
        json.dump(doc, f)
    with pytest.raises(serde.OpVersionError, match="version 99"):
        serde.load_program(path)
    doc["format_version"] = serde.FORMAT_VERSION + 1
    with open(path + ".pdmodel", "w") as f:
        json.dump(doc, f)
    with pytest.raises(serde.OpVersionError, match="format_version"):
        serde.load_program(path)


def test_unknown_op_and_missing_sidecar_raise(P, tmp_path):
    serde = _serde(P)
    path = _save(P, _small_net(P), tmp_path)
    with open(path + ".pdmodel") as f:
        doc = json.load(f)
    doc["ops"][0]["fn"]["__opreg__"] = "no_such_op"
    with open(path + ".pdmodel", "w") as f:
        json.dump(doc, f)
    with pytest.raises(serde.OpVersionError, match="no_such_op"):
        serde.load_program(path)
    os.remove(path + ".pdmodel.npz")
    with pytest.raises(serde.OpVersionError, match="npz"):
        serde.load_program(path)


def test_dtype_attrs_are_numpy_names(tmp_path):
    """A torch dtype attr is written under its numpy name, bfloat16 too,
    and reads back as the torch dtype."""
    import torch
    PORT.paddle.enable_static()
    try:
        main = PORT.static.Program("c")
        with PORT.static.program_guard(main):
            x = PORT.static.data("x", [2], "float32")
            y = PORT.ops.cast(PORT.ops.cast(x, torch.bfloat16),
                              torch.float32)
    finally:
        PORT.paddle.disable_static()
    main._jit_fetch_vars = [y]
    path = str(tmp_path / "c")
    _serde(PORT).save_program(main, path, feed_names=["x"])
    with open(path + ".pdmodel") as f:
        doc = json.load(f)
    dts = json.dumps([[op["args"], op["kwargs"]] for op in doc["ops"]])
    assert '{"__dtype__": "bfloat16"}' in dts
    assert '{"__dtype__": "float32"}' in dts
    prog, _ = _serde(PORT).load_program(path)
    assert torch.bfloat16 in prog.ops[0].flat
    (out,) = PORT.static.Executor().run(
        prog, feed={"x": np.array([1.5, 2.0], "float32")},
        fetch_list=prog._jit_fetch_vars)
    np.testing.assert_array_equal(out, [1.5, 2.0])


# ---------------------------------------------------------------------------
# artifacts across packages
# ---------------------------------------------------------------------------

def _bert(P, seq):
    from importlib import import_module
    m = import_module(P.paddle.__name__ + ".text.models.bert")
    cfg = m.BertConfig.tiny()
    cfg.max_position_embeddings = max(128, seq)
    return (m.Bert(cfg) if P is JAX else m.Bert(cfg, device="cpu")), \
        cfg.vocab_size


def _gpt(P, seq):
    from importlib import import_module
    m = import_module(P.paddle.__name__ + ".text.models.gpt")
    cfg = m.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                      num_heads=2, intermediate_size=128, max_seq_len=128)
    return (m.GPT(cfg) if P is JAX else m.GPT(cfg, device="cpu")), \
        cfg.vocab_size


MODELS = {"bert": _bert, "gpt": _gpt}


def _pair(kind, seq):
    jnet, vocab = MODELS[kind](JAX, seq)
    tnet, _ = MODELS[kind](PORT, seq)
    params, _ = jnet.functional_state()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in params.items()})
    jnet.eval()
    tnet.eval()
    ids = np.random.RandomState(5).randint(0, vocab, (2, seq)) \
        .astype("int64")
    return jnet, tnet, ids


def _close(got, want, tol=1e-5):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def _ops_of(path):
    with open(path + ".pdmodel") as f:
        return {op["fn"].get("__opreg__") for op in json.load(f)["ops"]}


def _jax_record_and_save(jnet, path, seq):
    """JAX's jit.save without its dy2static step: the eval forward
    recorded in JAX's static mode (eager parameters baked in as
    constants) and written by JAX's save_program. JAX's own jit.save of
    these models fails in its rewriter (MultiHeadAttention.forward's
    folded early return reads ``k`` unbound; the port's rewriter threads
    it, ``test_known_fault_jax_jit_save_of_mha``)."""
    from paddle_tpu.framework.program_serde import save_program
    jp.enable_static()
    try:
        prog = JAX.static.Program("inference")
        with JAX.static.program_guard(prog):
            x = JAX.static.data("x", [2, seq], "int64")
            out = jnet(x)
    finally:
        jp.disable_static()
    prog._jit_fetch_vars = [out]
    save_program(prog, path, feed_names=["x"])
    return path


def test_known_fault_jax_jit_save_of_mha(tmp_path):
    jnet, tnet, ids = _pair("bert", 16)
    with pytest.raises(ValueError, match="undefined local"):
        _save(JAX, jnet, tmp_path, "jax_bert", shape=(2, 16),
              dtype="int64")
    _save(PORT, tnet, tmp_path, "port_bert", shape=(2, 16), dtype="int64")


@pytest.mark.parametrize("kind", list(MODELS))
def test_jax_artifact_runs_in_the_port(kind, tmp_path):
    jnet, tnet, ids = _pair(kind, 16)
    want = to_np(jnet(jp.to_tensor(ids)))
    path = _jax_record_and_save(jnet, str(tmp_path / ("jax_" + kind)), 16)
    assert "sdpa" in _ops_of(path)
    loaded = PORT.jit.load(path)
    got = to_np(loaded(PORT.paddle.to_tensor(ids)))
    _close(got, want)
    _close(to_np(tnet(PORT.paddle.to_tensor(ids))), want)


@pytest.mark.parametrize("kind", list(MODELS))
def test_port_artifact_runs_in_jax(kind, tmp_path):
    jnet, tnet, ids = _pair(kind, 16)
    want = to_np(tnet(PORT.paddle.to_tensor(ids)))
    path = _save(PORT, tnet, tmp_path, "port_" + kind, shape=(2, 16),
                 dtype="int64")
    assert "sdpa" in _ops_of(path)
    got = to_np(JAX.jit.load(path)(jp.to_tensor(ids)))
    _close(got, want)


def test_port_flash_artifact_runs_in_jax_interpret(tmp_path):
    """At s 128 the port's gate records flash_sdpa (no backend reason);
    JAX's loader runs it through the Pallas kernel in interpret mode."""
    jnet, tnet, ids = _pair("bert", 128)
    want = to_np(tnet(PORT.paddle.to_tensor(ids)))
    path = _save(PORT, tnet, tmp_path, "port_flash", shape=(2, 128),
                 dtype="int64")
    assert "flash_sdpa" in _ops_of(path)
    old = jflags.flag("FLAGS_pallas_interpret")
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        got = to_np(JAX.jit.load(path)(jp.to_tensor(ids)))
    finally:
        jflags.set_flags({"FLAGS_pallas_interpret": old})
    _close(got, want, 1e-4)


def test_port_fused_ce_program_runs_in_jax(tmp_path):
    """A static BERT with the fused MLM loss records fused_ce_op; saved
    with save_inference_model, JAX's loader gives the port's loss."""
    _, tnet, ids = _pair("bert", 16)
    labels = np.where(np.random.RandomState(6).rand(2, 16) < 0.3, ids,
                      -100).astype("int64")
    from importlib import import_module
    tbert = import_module("paddle_tpu_torch.text.models.bert")
    PORT.paddle.enable_static()
    try:
        main = PORT.static.Program("mlm")
        with PORT.static.program_guard(main):
            x = PORT.static.data("ids", [2, 16], "int64")
            y = PORT.static.data("labels", [2, 16], "int64")
            cfg = tbert.BertConfig.tiny()
            cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.
            snet = tbert.Bert(cfg)
            loss = snet(x, masked_lm_labels=y)
    finally:
        PORT.paddle.disable_static()
    from paddle_tpu_torch.bridge import load_jax_static_params
    load_jax_static_params(snet, {k: to_np(v) for k, v in
                                  tnet.named_parameters()})
    exe = PORT.static.Executor()
    (want,) = exe.run(main, feed={"ids": ids, "labels": labels},
                      fetch_list=[loss])
    path = str(tmp_path / "mlm")
    PORT.static.save_inference_model(path, [x, y], [loss], exe,
                                     program=main)
    assert "fused_ce_op" in _ops_of(path)
    # the artifact through JAX's loader: the .pdmodel and the port's
    # .pdiparams, which JAX's framework.io.load reads
    jprog, feed_names, fetch_vars = JAX.static.load_inference_model(path)
    assert sorted(feed_names) == ["ids", "labels"]
    old = jflags.flag("FLAGS_pallas_interpret")
    jflags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        (got,) = JAX.static.Executor().run(
            jprog, feed={"ids": ids, "labels": labels},
            fetch_list=fetch_vars)
    finally:
        jflags.set_flags({"FLAGS_pallas_interpret": old})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
