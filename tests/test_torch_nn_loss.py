"""Port parity: the loss layers of paddle_tpu_torch/nn/layer/loss.py
against paddle_tpu's, every layer at every reduction, the loss and the
gradients of its inputs within 1e-5 (f32)."""
import numpy as np
import pytest
import torch

import test_torch_nn_cases as C
from paddle_tpu_torch import device as tdevice


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


X = C.f32(6, 5, seed=1)
Y = C.f32(6, 5, seed=2)
LOGITS = C.f32(6, 5, seed=3, scale=2.0)
LABELS = np.array([0, 4, -100, 2, 1, 3], np.int64)
PROB = 1.0 / (1.0 + np.exp(-LOGITS))
BIN = (C.rs(4).rand(6, 5) > 0.5).astype(np.float32)
LOGP = LOGITS - np.log(np.exp(LOGITS).sum(1, keepdims=True))
TARGET = np.exp(C.f32(6, 5, seed=5))
TARGET = (TARGET / TARGET.sum(1, keepdims=True)).astype(np.float32)
SIGN = np.where(C.f32(6, 5, seed=6) > 0, 1.0, -1.0).astype(np.float32)
ROW_SIGN = np.array([1, -1, 1, 1, -1, -1], np.int64)

LOSSES = {
    "MSELoss": ({}, [X, Y]),
    "L1Loss": ({}, [X, Y]),
    "NLLLoss": ({}, [LOGP.astype(np.float32), LABELS]),
    "BCELoss": ({}, [PROB.astype(np.float32), BIN]),
    "BCEWithLogitsLoss": ({}, [LOGITS, BIN]),
    "KLDivLoss": ({}, [LOGP.astype(np.float32), TARGET]),
    "SmoothL1Loss": ({"delta": 0.5}, [X * 2, Y]),
    "HuberLoss": ({"delta": 0.5}, [X * 2, Y]),
    "MarginRankingLoss": ({"margin": 0.1}, [X, Y, SIGN]),
    "HingeEmbeddingLoss": ({"margin": 0.5}, [X, SIGN]),
    "TripletMarginLoss": ({"margin": 0.5}, [X, Y, C.f32(6, 5, seed=7)]),
    "CosineEmbeddingLoss": ({"margin": 0.2}, [X, Y, ROW_SIGN]),
    "CrossEntropyLoss": ({}, [LOGITS, LABELS]),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_layer_matches_jax(name, reduction):
    kw, inputs = LOSSES[name]
    C.check(lambda pkg: getattr(pkg.nn, name)(reduction=reduction, **kw),
            inputs)


@pytest.mark.parametrize("name, kw", [
    ("NLLLoss", {"weight": np.linspace(0.5, 1.5, 5).astype(np.float32)}),
    ("BCELoss", {"weight": np.linspace(0.5, 1.5, 5).astype(np.float32)}),
    ("BCEWithLogitsLoss",
     {"pos_weight": np.linspace(0.5, 2.0, 5).astype(np.float32)}),
])
def test_weighted_loss_matches_jax(name, kw):
    _, inputs = LOSSES[name]

    def make(pkg):
        return getattr(pkg.nn, name)(**{k: pkg.to_tensor(v)
                                        for k, v in kw.items()})
    C.check(make, inputs)


def test_kl_div_batchmean_matches_jax():
    C.check(lambda pkg: pkg.nn.KLDivLoss("batchmean"), LOSSES["KLDivLoss"][1])
