"""Port parity: ``paddle.flops`` (paddle_tpu_torch/hapi/summary.py over
core/flop_count.py) against the JAX package's XLA count, on the CPU.

Four nets, each built in both packages: an MLP, LeNet, a tiny BERT and a
tiny GPT. The port's matrix-product part (``matmul_flops``) must equal 2
x the multiply-adds worked out here from the layer shapes, exactly. The
total must lie within ``TOTAL_TOL`` (10%) of XLA's, and its residual
against XLA's is a known difference held at its recorded value
(``RESIDUAL``, to 0.5 points):

- MLP 0: the products and the bias adds, as XLA.
- LeNet +0.35%: the conv bias and pooling rules against XLA's.
- BERT -7.16%, GPT -5.91%: XLA's CPU compiler expands ``erf`` (GELU)
  into a polynomial of about 60 FLOPs an element; the port counts GELU's
  composite arithmetic, 4 an element, and its transcendentals as 0, as
  XLA counts ``exp`` or ``tanh``.

``flops`` keeps the net usable and every sublayer's mode, as the JAX
package's does (``tests/test_hapi_model.py``). On the card the count is
the same as on the CPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 29(b)).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.text.models import bert as jbert
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.core.flop_count import FlopCounter
from paddle_tpu_torch.hapi.summary import _example_inputs
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.nn.layer.conv import Conv2D
from paddle_tpu_torch.text.models import bert as tbert
from paddle_tpu_torch.text.models import gpt as tgpt

TOTAL_TOL = 0.10
RESIDUAL = {"mlp": 0.0, "lenet": 0.0035, "bert": -0.0716, "gpt": -0.0591}
GPT = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_seq_len=64)
SEQ = 16


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


def _nets(P, B, G):
    P.seed(0)
    return {
        "mlp": (P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                                P.nn.Linear(16, 4)), [1, 8], None),
        "lenet": (P.vision.models.LeNet(), [1, 1, 28, 28], None),
        "bert": (B.Bert(B.BertConfig.tiny()), [1, SEQ], ["int64"]),
        "gpt": (G.GPT(G.GPTConfig(**GPT)), [1, SEQ], ["int64"]),
    }


@pytest.fixture(scope="module")
def jax_counts():
    return {k: jp.flops(net, size, dt)
            for k, (net, size, dt) in _nets(jp, jbert, jgpt).items()}


@pytest.fixture(scope="module")
def port_nets():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        return _nets(tp, tbert, tgpt)


def _shape_macs(name, net, size, dtypes):
    """Multiply-adds from the layer shapes: each Linear's outputs x its
    inputs, each conv's outputs x its window, and the attention and head
    products from the config."""
    macs = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, Linear):
            macs[0] += out.numel() * mod.weight.shape[0]
        else:
            w = mod.weight
            macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, (Linear, Conv2D))]
    try:
        with torch.no_grad():
            net.eval()
            net(*_example_inputs(size, dtypes, torch.device("cpu")))
    finally:
        for h in hs:
            h.remove()
    if name in ("bert", "gpt"):
        cfg = net.cfg if hasattr(net, "cfg") else net.config
        hid = cfg.hidden_size
        layers = getattr(cfg, "num_hidden_layers", None) or cfg.num_layers
        # QKᵀ and PV: seq x seq x hidden each, a layer
        macs[0] += layers * 2 * SEQ * SEQ * hid
        # the tied vocabulary head: seq x hidden x vocab
        macs[0] += SEQ * hid * cfg.vocab_size
    return 2 * macs[0]


@pytest.mark.parametrize("name", ["mlp", "lenet", "bert", "gpt"])
def test_flops_against_xla_and_the_shapes(name, jax_counts, port_nets):
    net, size, dt = port_nets[name]
    total = tp.flops(net, size, dt)
    net.eval()
    with torch.no_grad(), FlopCounter() as c:
        net(*_example_inputs(size, dt, torch.device("cpu")))
    net.train()
    assert c.flops == total
    assert c.matmul_flops == _shape_macs(name, net, size, dt)
    resid = (total - jax_counts[name]) / jax_counts[name]
    assert abs(resid) <= TOTAL_TOL
    assert abs(resid - RESIDUAL[name]) <= 0.005, (name, resid)


def test_flops_leaves_net_usable_and_modes_intact(capsys):
    tp.seed(1)
    nn = tp.nn
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1D(8), nn.Linear(8, 2))
    net.train()
    net[1].eval()  # deliberately frozen BN
    f = tp.flops(net, (2, 4), print_detail=True)
    assert "Total FLOPs" in capsys.readouterr().out
    assert f >= 2 * 2 * (4 * 8 + 8 * 2)
    assert net.training and not net[1].training  # modes preserved
    out = net(tp.to_tensor(np.ones((2, 4), "float32")))
    assert np.isfinite(out.detach().numpy()).all()
    from paddle_tpu_torch.hapi.model import InputSpec
    info = tp.summary(net, InputSpec([None, 4], "float32"))
    m = tp.Model(net)
    assert m.summary((2, 4))["total_params"] == info["total_params"] > 0


def test_kernel_wrappers_count_their_formula_on_the_cpu():
    """The flash forward counts 4·bh·sq·sk·d plus 6 a score, whatever
    runs inside it (here its plain version)."""
    from paddle_tpu_torch.ops.cuda import flash_fwd, fused_ce_fwd
    q = torch.randn(4, 16, 8)
    k = torch.randn(4, 24, 8)
    with FlopCounter() as c:
        flash_fwd(q, k, k)
    assert c.matmul_flops == 4 * 4 * 16 * 24 * 8
    assert c.flops == c.matmul_flops + 6 * 4 * 16 * 24
    assert set(c.by_op) == {"flash_fwd"}
    h, w = torch.randn(8, 16), torch.randn(30, 16)
    with FlopCounter() as c:
        fused_ce_fwd(h, w, torch.zeros(30), torch.arange(8))
    assert c.matmul_flops == 2 * 8 * 16 * 30
    assert c.flops == c.matmul_flops + 4 * 8 * 30 + 2 * 8
    with pytest.raises(RuntimeError, match="already counting"):
        with FlopCounter(), FlopCounter():
            pass
