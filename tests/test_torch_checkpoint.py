"""Port parity: the training checkpoints (paddle_tpu_torch/incubate/
checkpoint.py) and ``Model.fit(auto_checkpoint_dir=...)`` against the
JAX package's.

- ``build_manifest`` equals JAX's on equal states (f32, bf16 — JAX's
  ml_dtypes arrays, the port's bf16 tensors — int64 and Python ints):
  the same leaf paths, shapes, dtypes and sha256s.
- A tiny BERT (MLM, AdamW, dropout on, a shuffled DataLoader) trained by
  ``Model.fit`` with auto-checkpointing in a child process that gets
  SIGTERM after step 5 (PreemptionGuard saves that step) resumes in a
  second child to the uninterrupted run's final parameters, bitwise, on
  the CPU.
- A step with one flipped byte is quarantined and the restore walks back
  to the step before; keep-latest-k, the async writer, and
  ``train_epoch_range`` as tests/test_auto_checkpoint.py checks them.
"""
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu.incubate import checkpoint as jck
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.incubate import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_manifest_equals_jax_on_equal_states():
    import ml_dtypes
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 5).astype("float32")
    bf = rng.randn(4, 2).astype("float32").astype(ml_dtypes.bfloat16)
    i64 = rng.randint(0, 100, (6,)).astype("int64")
    jstate = {"model": {"w": f32, "b": bf}, "opt": {"t": i64, "n": 7},
              "list": [np.float32(2.5), np.arange(3, dtype="int32")]}
    tstate = {"model": {"w": torch.from_numpy(f32.copy()),
                        "b": torch.from_numpy(bf.astype("float32"))
                        .to(torch.bfloat16)},
              "opt": {"t": torch.from_numpy(i64.copy()), "n": 7},
              "list": (np.float32(2.5), torch.arange(3, dtype=torch.int32))}
    jm = jck.build_manifest(3, jstate)
    tm = tck.build_manifest(3, tstate)
    assert tm["leaves"] == jm["leaves"]
    assert tm["leaves"]["model/b"]["dtype"] == "bfloat16"
    assert (tm["step"], tm["manifest_version"]) == (jm["step"],
                                                    jm["manifest_version"])
    # the port's verify accepts the JAX manifest of the same state
    tck.verify_manifest(3, tstate, jm)
    tstate["model"]["b"][0, 0] += 1
    with pytest.raises(tck.CheckpointCorruptError, match="model/b"):
        tck.verify_manifest(3, tstate, jm)


def _state(k):
    return {"w": torch.full((4, 4), float(k)),
            "h": torch.full((3,), float(k), dtype=torch.bfloat16),
            "counters": {"step": k}, "arr": np.arange(k + 1)}


@pytest.mark.parametrize("async_save", [False, True])
def test_roundtrip_keep_latest_and_async(tmp_path, async_save):
    ck = tck.TrainingCheckpoint(str(tmp_path / "c"), keep=2,
                                async_save=async_save)
    for s in (1, 2, 3):
        st = _state(s)
        ck.save(s, st)
        st["w"].fill_(-1.0)            # the save took its own host copy
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got = ck.restore()
    assert torch.equal(got["w"], torch.full((4, 4), 3.0))
    assert got["h"].dtype == torch.bfloat16
    assert got["counters"]["step"] == 3
    np.testing.assert_array_equal(got["arr"], np.arange(4))
    assert ck.restore(step=1) is None
    names = sorted(os.listdir(ck.directory))
    assert names == ["2", "3", "manifest_2.json", "manifest_3.json"]
    ck.close()


def _flip_byte(path, frac=0.5):
    with open(path, "r+b") as f:
        f.seek(0, 2)
        pos = int(f.tell() * frac)
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x01]))


def test_corrupt_step_quarantined_and_restore_walks_back(tmp_path):
    ck = tck.TrainingCheckpoint(str(tmp_path / "c"), keep=3,
                                async_save=False)
    for s in (10, 20):
        st = _state(s)
        st["big"] = torch.arange(20000, dtype=torch.float32)
        ck.save(s, st)
    # the byte in the middle of the big tensor's data of step 20
    with open(os.path.join(ck.directory, "20", "state.pt"), "rb") as f:
        raw = f.read()
    pos = raw.index(torch.arange(20000, dtype=torch.float32)[10000:10001]
                    .numpy().tobytes())
    _flip_byte(os.path.join(ck.directory, "20", "state.pt"),
               frac=pos / len(raw))
    with pytest.raises(tck.CheckpointCorruptError, match="big"):
        ck.restore(step=20)
    before = tmonitor.stat_get("ckpt.corrupt_skipped")
    got = ck.restore()
    assert got["counters"]["step"] == 10
    assert tmonitor.stat_get("ckpt.corrupt_skipped") - before == 1
    assert ck.all_steps() == [10]
    q = os.listdir(os.path.join(ck.directory, ".quarantine"))
    assert any(n.startswith("20_") and not n.endswith(".json") for n in q)


def test_torn_step_is_quarantined(tmp_path):
    ck = tck.TrainingCheckpoint(str(tmp_path / "c"), keep=3,
                                async_save=False)
    ck.save(1, _state(1))
    ck.save(2, _state(2))
    with open(os.path.join(ck.directory, "2", "state.pt"), "wb") as f:
        f.write(b"torn")
    assert ck.restore()["counters"]["step"] == 1


def test_train_epoch_range_resumes(tmp_path):
    d = str(tmp_path / "er")
    seen = []
    for epoch in tck.train_epoch_range(3, directory=d):
        seen.append(epoch)
        if epoch == 1:
            break
    assert seen == [0, 1]
    assert list(tck.train_epoch_range(3, directory=d)) == [1, 2]


CHILD = textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    import torch
    sys.path.insert(0, {root!r})
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.text.datasets import LMDataset
    from paddle_tpu_torch.text.models import Bert, BertConfig

    mode, ckpt, out = sys.argv[1], sys.argv[2], sys.argv[3]

    class MLM(torch.nn.Module):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, ids, labels=None):
            return self.bert(ids, masked_lm_labels=labels)

    class Term(Callback):
        def on_train_batch_end(self, step, logs=None):
            if mode == "kill" and step == 4:        # after step 5
                os.kill(os.getpid(), signal.SIGTERM)

    with device_scope("cpu"):
        pt.seed(0)
        np.random.seed(0)
        cfg = BertConfig.tiny()
        cfg.num_hidden_layers = 1
        net = MLM(Bert(cfg, device="cpu", seed=0))
        model = pt.Model(net, inputs=[
            pt.InputSpec([None, None], "int64", "ids"),
            pt.InputSpec([None, None], "int64", "labels")])
        opt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=model.parameters())
        model.prepare(opt, loss=lambda l: l)
        ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=16, n=48, seed=1)
        kw = {{}} if mode == "ref" else dict(
            auto_checkpoint_dir=ckpt, auto_checkpoint_freq=2,
            keep_checkpoint_max=2)
        model.fit(ds, batch_size=4, epochs=1, shuffle=True, verbose=0,
                  callbacks=[Term()], **kw)
        pt.save(dict(net.state_dict()), out)
        print("steps", model._optimizer._step_count)
""")


def _child(tmp_path, mode, ckpt, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", CHILD.format(root=ROOT), mode, ckpt, out],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)


def test_sigterm_and_resume_end_on_the_uninterrupted_parameters(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ref = _child(tmp_path, "ref", ckpt, str(tmp_path / "ref.pdparams"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    killed = _child(tmp_path, "kill", ckpt, str(tmp_path / "no.pdparams"))
    assert killed.returncode == -signal.SIGTERM, (killed.returncode,
                                                  killed.stderr[-3000:])
    ck = tck.TrainingCheckpoint(ckpt)
    assert ck.all_steps() == [4, 5]      # periodic 2, 4; the guard's 5
    assert ck.restore()["counters"] == {"epoch": 0, "step": 4,
                                        "global_step": 5}
    resumed = _child(tmp_path, "resume", ckpt, str(tmp_path / "res.pdparams"))
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "steps 12" in resumed.stdout and "steps 12" in ref.stdout
    from paddle_tpu_torch.framework.io import load
    want, got = load(str(tmp_path / "ref.pdparams")), \
        load(str(tmp_path / "res.pdparams"))
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
