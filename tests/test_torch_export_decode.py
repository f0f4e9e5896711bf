"""Port parity: ``export_decode`` (paddle_tpu_torch/text/models/gpt.py)
through the Predictor (paddle_tpu_torch/inference) against JAX's
StableHLO artifact through JAX's Predictor.

Tiny GPT, f32, JAX's weights, b 2, prompt 12, 5 new tokens, greedy: the
port's artifact gives JAX's Predictor's tokens and ``generate``'s; the
``.pdinfer.json`` decode fields equal JAX's; the exported graph holds the
decode kernel's custom op (one node a layer a pass), so running the
program on the card launches the kernel.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import inference as jinference
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.text.models.gpt import export_decode as jexport_decode
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig, export_decode

B, S, NEW = 2, 12, 5


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(scope="module")
def nets():
    jpaddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def artifacts(nets, tmp_path_factory):
    jnet, tnet = nets
    d = tmp_path_factory.mktemp("export")
    jexport_decode(jnet, str(d / "jax"), batch_size=B, prompt_len=S,
                   max_new_tokens=NEW)
    with tdevice.device_scope("cpu"):
        export_decode(tnet, str(d / "port"), batch_size=B, prompt_len=S,
                      max_new_tokens=NEW)
    return str(d / "jax"), str(d / "port")


IDS = np.random.RandomState(9).randint(0, 1000, (B, S)).astype(np.int32)


def test_predictor_tokens_equal_jax_predictor_and_generate(nets, artifacts):
    jnet, tnet = nets
    jpath, tpath = artifacts
    (jtoks,) = jinference.create_predictor(jinference.Config(jpath)).run(
        [IDS, np.int32(0)])
    pred = inference.create_predictor(inference.Config(tpath))
    (toks,) = pred.run([IDS, np.int32(0)])
    ref = tnet.generate(IDS.astype(np.int64), max_new_tokens=NEW,
                        temperature=0).numpy()[:, S:]
    assert toks.dtype == np.int32 and toks.shape == (B, NEW)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(toks.astype(np.int64), ref)
    # the zero-copy handles give the same
    for name, arr in zip(pred.get_input_names(), (IDS, np.int32(0))):
        pred.get_input_handle(name).copy_from_cpu(arr)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0])
    np.testing.assert_array_equal(out.copy_to_cpu(), toks)
    assert out.shape() == [B, NEW]


def test_pdinfer_json_decode_fields_equal_jax(artifacts):
    jpath, tpath = artifacts
    jmeta = json.load(open(jpath + ".pdinfer.json"))
    meta = json.load(open(tpath + ".pdinfer.json"))
    assert meta.pop("device") == "cpu"
    assert meta == jmeta


def test_exported_graph_holds_the_decode_kernel_op(artifacts):
    _, tpath = artifacts
    prog = torch.export.load(tpath + ".pt2")
    ops = [n for n in prog.graph.nodes if n.op == "call_function"
           and "paddle_tpu_torch.decode_attention" in str(n.target)]
    layers = GPTConfig.tiny().num_layers
    assert len(ops) == layers * NEW      # the prefill and NEW - 1 steps
    assert not any("decode_attention_ref" in str(n.target)
                   for n in prog.graph.nodes)


def test_eos_rows_freeze_as_generate(nets, tmp_path):
    _, tnet = nets
    ref = tnet.generate(IDS.astype(np.int64), max_new_tokens=NEW,
                        temperature=0).numpy()[:, S:]
    eos = int(ref[0, 1])
    path = str(tmp_path / "eos")
    export_decode(tnet, path, B, S, NEW, eos_token_id=eos)
    (toks,) = inference.create_predictor(path + ".pt2").run(
        [IDS, np.int32(3)])
    want = tnet.generate(IDS.astype(np.int64), max_new_tokens=NEW,
                         temperature=0, eos_token_id=eos).numpy()[:, S:]
    np.testing.assert_array_equal(toks.astype(np.int64), want)
    assert (toks[0, 1:] == eos).all()


def test_left_out_paths_raise_naming_their_item(nets, tmp_path):
    _, tnet = nets
    with pytest.raises(NotImplementedError, match="greedy"):
        export_decode(tnet, str(tmp_path / "t"), B, S, NEW, temperature=0.7)
    with pytest.raises(ValueError, match="max_seq_len"):
        export_decode(tnet, str(tmp_path / "t"), B, 120, 20)
    # item 6a's paths work now: encrypting needs the artifact, and a
    # Predictor without a .pt2 reads the .pdmodel (absent here)
    with pytest.raises(FileNotFoundError):
        inference.encrypt_model(str(tmp_path / "t"), b"k" * 32)
    cfg = inference.Config(str(tmp_path / "t"))
    cfg.set_cipher_key(b"k" * 32)
    assert cfg._cipher_key == b"k" * 32
    (tmp_path / "prog.pdinfer.json").write_text(json.dumps(
        {"input_names": ["x"], "output_names": ["y"]}))
    with pytest.raises(FileNotFoundError, match="pdmodel"):
        inference.Predictor(str(tmp_path / "prog.pdmodel"))
    with pytest.raises(FileNotFoundError):
        inference.Predictor(str(tmp_path / "none"))
