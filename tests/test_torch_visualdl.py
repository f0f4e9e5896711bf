"""Port parity: ``utils/log_writer.py`` and the ``VisualDL`` callback
(paddle_tpu_torch) against the JAX package's: the records written are
JAX's (tag, value and step; ``wall_time`` is the clock's), and under the
async fit loop the default ``sample_freq`` reads no loss before fit's own
window drain (tests/test_visualdl_async.py's spy on ``_LazyLoss``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.hapi.callbacks import VisualDL as JVisualDL
from paddle_tpu.utils import log_writer as jlw
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.hapi import model as tmodel
from paddle_tpu_torch.hapi.callbacks import VisualDL as TVisualDL
from paddle_tpu_torch.utils import log_writer as tlw

import paddle_tpu_torch as pt

N_BATCHES, LOG_FREQ = 20, 10


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _strip(recs):
    return [(r["tag"], r["value"], r["step"]) for r in recs]


def test_log_writer_records_equal_jax(tmp_path):
    recs = {}
    for name, lw in (("jax", jlw), ("port", tlw)):
        d = str(tmp_path / name)
        with lw.LogWriter(d) as w:
            w.add_scalar("train/loss", np.float32(0.5), 1)
            w.add_scalars("eval", {"acc": 0.25, "loss": 2}, 3)
        recs[name] = lw.read_scalars(d)
        assert _strip(lw.read_scalars(d, tag="eval/acc")) == [
            ("eval/acc", 0.25, 3)]
    assert _strip(recs["port"]) == _strip(recs["jax"])
    assert set(recs["port"][0]) == set(recs["jax"][0])


def _fit(tmp_path, pkg, sample_freq, epochs=1, n_batches=N_BATCHES,
         spy=None):
    x = np.random.RandomState(0).rand(n_batches * 2, 4).astype("float32")
    y = x.sum(axis=1, keepdims=True).astype("float32")
    jp.seed(7)
    jnet = jp.nn.Linear(4, 1)
    if pkg == "jax":
        model = jp.Model(jnet)
        opt = jp.optimizer.SGD(learning_rate=0.01,
                               parameters=model.parameters())
        loss, ds, vdl = jp.nn.MSELoss(), jp.io.TensorDataset([x, y]), \
            JVisualDL
    else:
        net = torch.nn.Sequential()
        net.lin = pt.nn.Linear(4, 1)
        load_jax_params(net, {f"lin.{k}": np.asarray(v) for k, v in
                              jnet.functional_state()[0].items()})
        model = pt.Model(net)
        opt = pt.optimizer.SGD(learning_rate=0.01,
                               parameters=model.parameters())
        loss, ds, vdl = pt.nn.MSELoss(), pt.io.TensorDataset([x, y]), \
            TVisualDL
    model.prepare(optimizer=opt, loss=loss)
    logdir = str(tmp_path / f"{pkg}_{sample_freq}_{epochs}")
    model.fit(ds, batch_size=2, epochs=epochs, verbose=0, log_freq=LOG_FREQ,
              callbacks=[vdl(logdir, sample_freq=sample_freq)],
              shuffle=False)
    lw = jlw if pkg == "jax" else tlw
    return lw.read_scalars(logdir)


def test_fit_records_equal_jax(tmp_path):
    got = {p: _fit(tmp_path, p, LOG_FREQ, epochs=2) for p in ("jax", "port")}
    tags = [r["tag"] for r in got["port"]]
    assert tags == [r["tag"] for r in got["jax"]]
    assert [r["step"] for r in got["port"]] == [r["step"]
                                                for r in got["jax"]]
    np.testing.assert_allclose([r["value"] for r in got["port"]],
                               [r["value"] for r in got["jax"]], rtol=1e-5)
    assert tags.count("train/loss") == 2 * N_BATCHES


def _forced(monkeypatch, tmp_path, sample_freq):
    forced = []
    orig = tmodel._LazyLoss.value

    def spy(self):
        if self._val is None:
            forced.append(self.step)
        return orig(self)
    monkeypatch.setattr(tmodel._LazyLoss, "value", spy)
    recs = _fit(tmp_path, "port", sample_freq)
    return forced, [r for r in recs if r["tag"] == "train/loss"]


def test_default_sample_freq_adds_no_syncs(monkeypatch, tmp_path):
    forced, recs = _forced(monkeypatch, tmp_path, LOG_FREQ)
    assert forced == []
    assert [r["step"] for r in recs] == list(range(1, N_BATCHES + 1))


def test_sample_freq_1_forces_per_batch_reads(monkeypatch, tmp_path):
    forced, recs = _forced(monkeypatch, tmp_path, 1)
    assert len(forced) > N_BATCHES // 2
    eager = [r["value"] for r in recs]
    _, lazy = _forced(monkeypatch, tmp_path / "lazy", LOG_FREQ)
    assert eager == [r["value"] for r in lazy]
