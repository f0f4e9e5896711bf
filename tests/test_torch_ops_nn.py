"""Port parity, op by op: the activation, normalization and loss ops, and
the attention and loss-head ops of nn/functional
(tests/test_torch_ops_cases.py holds the cases; each runs the JAX op and
the port's of the same registry name on the same seeded numpy inputs,
forward and gradients, within the case's tolerance, f32 rtol 1e-5 and
atol 1e-6 unless it says otherwise)."""
import pytest
import torch
import paddle_tpu as jp
import test_torch_ops_cases as P
from paddle_tpu_torch import device as tdevice


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


@pytest.fixture(autouse=True, scope="module")
def _kernels_in_interpret_mode():
    """The JAX package's flash and fused-CE kernels run in interpret mode
    on the CPU (their ops sit behind these flags)."""
    jp.set_flags({"FLAGS_pallas_interpret": True,
                  "FLAGS_flash_attention_interpret": True})
    yield
    jp.set_flags({"FLAGS_pallas_interpret": False,
                  "FLAGS_flash_attention_interpret": False})


@pytest.mark.parametrize("case", P.ACTIVATION + P.NORM + P.LOSS + P.HEAD
                         + P.RNN, ids=str)
def test_op_matches_jax(case):
    P.run(case)


@pytest.mark.parametrize("op", ["binary_cross_entropy_with_logits",
                                "rank_loss"])
def test_sigmoid_ce_subgradients_at_zero_equal_jax(op):
    """Queue 3 G1: at a logit of exactly 0 (a zero-initialized embedding
    row, say) the sigmoid cross entropy's gradient is the JAX package's:
    ``maximum`` splits its tie and ``|x|`` has slope 1 there (torch's
    ``clamp_min`` passes 1 and ``abs`` 0, which gave 0.25 where JAX gives
    0 and 0 where it gives -0.25). Exact."""
    import numpy as np
    import paddle_tpu_torch as tp
    x = np.zeros((4, 1), np.float32)
    y = np.array([[0.0], [1.0], [0.0], [1.0]], np.float32)
    grads = {}
    for name, pkg in (("jax", jp), ("port", tp)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        yt = pkg.to_tensor(y)
        if op == "rank_loss":
            out = pkg.ops.rank_loss(yt, xt, pkg.to_tensor(x))
        else:
            out = pkg.nn.functional.binary_cross_entropy_with_logits(xt, yt)
        pkg.ops.mean(out).backward()
        g = xt.grad
        grads[name] = np.asarray(g.numpy() if hasattr(g, "numpy") else g)
    np.testing.assert_array_equal(grads["port"], grads["jax"])
    assert grads["port"][1, 0] != 0.0
